"""The W8A8 serving path of the PyTorch port against the JAX package: the split
RoPE layout, the serving norms, the tiny W8A8 DiT forward and denoise loop, the
fused-kernel dispatch, and the `--quantize int8` CLI profile.

Both packages hold the same seeded numpy weights (`test_torch_quant.
numpy_models`) and run their own fuse + permute + quantize; inputs are seeded
numpy arrays handed to both. The port's "pallas" forward runs K1–K5's plain
versions on the CPU; the JAX package runs attn_impl="pallas_interpret" (its
Pallas kernels in interpret mode). Bounds: fp32 outputs cosine >= 0.9999, bf16
cosine >= 0.999 (int8 activation rounding can flip where the two frameworks'
sums differ in the last bit); the split rotation and serving norms in fp32
within 1e-5.
"""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.models.flux.dit import _adaln_fast as j_adaln_fast
from reflectionflow_tpu.models.flux.dit import _rms_fast as j_rms_fast
from reflectionflow_tpu.models.flux.dit import flux_dit_apply
from reflectionflow_tpu.sampler.generate import denoise as jax_denoise
from reflectionflow_tpu_torch.cli.common import load_config, load_pipeline
from reflectionflow_tpu_torch.models.flux import rope as trope
from reflectionflow_tpu_torch.models.flux.dit import _adaln_fast, _rms_fast
from reflectionflow_tpu_torch.ops import fused_quant as fq
from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule

from test_torch_quant import _jax_serving, _port_serving, numpy_models

torch.set_num_threads(1)
B, TY, TX = 2, 4, 4
MIN_SIZE = 4096  # quantizes every block linear of the test config


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _inputs(cfg, lt, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        img=rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32),
        txt=rng.standard_normal((B, lt, cfg.text_dim), dtype=np.float32),
        pooled=rng.standard_normal((B, cfg.pooled_dim), dtype=np.float32),
        timestep=np.asarray([0.7, 0.3], np.float32),
        img_ids=jrope.make_image_ids(TY, TX),
        txt_ids=jrope.make_text_ids(lt),
    )


def _serving_pair(dtype=torch.float32, exclude=()):
    jcfg, params, dit = numpy_models(seed=5)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tree = _jax_serving(jax.tree.map(lambda a: jnp.asarray(a, jdt), params), jcfg, MIN_SIZE, exclude)
    return jcfg, tree, _port_serving(dit.to(dtype), MIN_SIZE, exclude)


def test_rope_split_matches_jax():
    rng = np.random.default_rng(1)
    ids = np.concatenate([jrope.make_text_ids(5), jrope.make_image_ids(3, 4)])
    jc, js = jrope.rope_tables(jnp.asarray(ids), (8, 12, 12))
    perm = trope.rope_split_perm(32)
    np.testing.assert_array_equal(perm, jrope.rope_split_perm(32))
    jc, js = np.asarray(jc)[:, perm], np.asarray(js)[:, perm]
    x = rng.standard_normal((2, len(ids), 3, 32)).astype(np.float32)
    for dt, tol in ((np.float32, 1e-6), (jnp.bfloat16, 2e-2)):  # bf16 tables: all-bf16 rotation
        tc, ts = (torch.from_numpy(np.asarray(a, np.float32)) for a in (jc, js))
        tx = torch.from_numpy(x)
        if dt != np.float32:
            tc, ts, tx = tc.bfloat16(), ts.bfloat16(), tx.bfloat16()
        want = np.asarray(jrope.apply_rope_split(jnp.asarray(x, dt), jnp.asarray(jc, dt), jnp.asarray(js, dt)),
                          np.float32)
        got = trope.apply_rope_split(tx, tc, ts)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_serving_norms_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    sh, sc = (rng.standard_normal((2, 64)).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(16).astype(np.float32)
    xh = x.reshape(2, 5, 4, 16)
    np.testing.assert_allclose(_rms_fast(torch.from_numpy(xh), torch.from_numpy(scale)).numpy(),
                               np.asarray(j_rms_fast(jnp.asarray(xh), jnp.asarray(scale))), atol=1e-5)
    np.testing.assert_allclose(
        _adaln_fast(*map(torch.from_numpy, (x, sh, sc))).numpy(),
        np.asarray(j_adaln_fast(*map(jnp.asarray, (x, sh, sc)))), atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_w8a8_forward_matches_jax(impl, dtype):
    jcfg, tree, dit = _serving_pair(dtype)
    x = _inputs(jcfg, lt=8)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    g = np.asarray([3.5, 3.5], np.float32)
    jx = {k: jnp.asarray(v, jdt if k in ("img", "txt", "pooled") else None) for k, v in x.items()}
    want = flux_dit_apply(tree, jcfg, **jx, guidance=jnp.asarray(g, jdt), rope_layout="split",
                          attn_impl="pallas_interpret" if impl == "pallas" else "xla")
    tx = {k: torch.from_numpy(v).to(dtype) if k in ("img", "txt", "pooled") else torch.from_numpy(v)
          for k, v in x.items()}
    with torch.no_grad():
        got = dit(**tx, guidance=torch.from_numpy(g).to(dtype), attn_impl=impl, rope_layout="split")
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    cos = _cos(got.float().numpy(), np.asarray(want, np.float32))
    assert cos >= (0.9999 if dtype == torch.float32 else 0.999), cos


def test_w8a8_denoise_matches_jax():
    """The slice as a whole: three Euler steps over the W8A8 split-layout DiT,
    fused path (txt length 8, where the JAX gate takes the fused path too)."""
    jcfg, tree, dit = _serving_pair(exclude=("_mod",))
    x = _inputs(jcfg, lt=8, seed=3)
    lat = np.random.default_rng(4).standard_normal((B, TY * TX, jcfg.in_channels)).astype(np.float32)
    sigmas = make_schedule(3, TY * TX)
    want = jax_denoise(tree, jcfg, *map(jnp.asarray, (lat, x["txt"], x["pooled"], x["img_ids"], x["txt_ids"])),
                       jnp.asarray(sigmas.numpy()), jnp.asarray(3.5), 3, attn_impl="pallas_interpret",
                       rope_layout="split")
    got = denoise(dit, *map(torch.from_numpy, (lat, x["txt"], x["pooled"], x["img_ids"], x["txt_ids"])),
                  sigmas, 3.5, 3, attn_impl="pallas", rope_layout="split")
    assert _cos(got.numpy(), np.asarray(want)) >= 0.9999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_w8a8_ragged_forward_matches_jax(dtype):
    """A txt length that is not a multiple of 8: the port runs K2–K5 (plain
    versions here) on both streams, where the JAX gate sends the txt stream,
    K2 and the single blocks to the unfused chain. Same outputs within the
    forward's bounds."""
    jcfg, tree, dit = _serving_pair(dtype)
    x = _inputs(jcfg, lt=6, seed=7)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    g = np.asarray([3.5, 3.5], np.float32)
    jx = {k: jnp.asarray(v, jdt if k in ("img", "txt", "pooled") else None) for k, v in x.items()}
    want = flux_dit_apply(tree, jcfg, **jx, guidance=jnp.asarray(g, jdt), rope_layout="split",
                          attn_impl="pallas_interpret")
    tx = {k: torch.from_numpy(v).to(dtype) if k in ("img", "txt", "pooled") else torch.from_numpy(v)
          for k, v in x.items()}
    with torch.no_grad():
        got = dit(**tx, guidance=torch.from_numpy(g).to(dtype), attn_impl="pallas", rope_layout="split")
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    cos = _cos(got.float().numpy(), np.asarray(want, np.float32))
    assert cos >= (0.9999 if dtype == torch.float32 else 0.999), cos


@pytest.mark.parametrize("lt", [8, 6], ids=["tileable", "ragged_txt"])
def test_fused_kernels_dispatch_as_jax(monkeypatch, lt):
    """Which W8A8 linears K2–K5 feed, counted through their plain versions on
    the CPU: per double block K2 x4, K3 x4, K4 x2, K5 x2; per single block
    K2 x2 and one each of K3–K5 (the JAX dispatch at a row-tileable length).
    A txt length that is not a multiple of 8 gets the same counts: the port
    has no L % 8 gate (the JAX one is the TPU kernels' row tiling)."""
    calls = {n: 0 for n in ("norm_rope_ref", "adaln_quant_ref", "gelu_quant_ref", "rowquant_ref")}

    def counted(name):
        fn = getattr(fq, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for name in calls:
        monkeypatch.setattr(fq, name, counted(name))
    jcfg, _, dit = numpy_models(seed=6)
    _port_serving(dit, MIN_SIZE, ())
    x = {k: torch.from_numpy(v) for k, v in _inputs(jcfg, lt).items()}
    with torch.no_grad():
        dit(**x, guidance=torch.full((B,), 3.5), attn_impl="pallas", rope_layout="split")
    nd, ns = jcfg.num_double_blocks, jcfg.num_single_blocks
    want = (4 * nd + 2 * ns, 4 * nd + ns, 2 * nd + ns, 2 * nd + ns)
    assert tuple(calls.values()) == want, calls
    # the "xla" serving path runs none of them
    for name in calls:
        calls[name] = 0
    with torch.no_grad():
        dit(**x, guidance=torch.full((B,), 3.5), attn_impl="xla", rope_layout="split")
    assert sum(calls.values()) == 0


def _tiny_cfg(tmp_path, **pipeline_args):
    cfg = {"pipeline_args": {"torch_dtype": "fp32", "height": 16, "width": 16,
                             "max_sequence_length": 8, "num_inference_steps": 2, **pipeline_args},
           "search_args": {"search_branch": 2, "search_rounds": 1}, "batch_size_for_img_gen": 2}
    path = tmp_path / f"cfg{len(list(tmp_path.glob('cfg*.json')))}.json"
    path.write_text(json.dumps(cfg))
    return path


def _args(cfg_path, quantize="int8"):
    return Namespace(pipeline_config_path=str(cfg_path), output_dir=None, synthetic_weights=True,
                     attn_impl="pallas", quantize=quantize, phase_swap=False, act_quant_exclude=[],
                     device="cpu")


def _load(cfg_path, quantize="int8"):
    args = _args(cfg_path, quantize)
    return load_pipeline(load_config(args), args)


def test_int8_profile_validation(tmp_path, monkeypatch):
    """The JAX CLI's t5_quant/dit_quant errors, raised the same way; the NF4
    profiles load and ask `FluxPipeline.quantize` for what the JAX CLI asks
    (its quantize recorded on a stub pipeline); the int8 profile makes the
    split serving layout."""
    from reflectionflow_tpu.cli import common as jcommon
    from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

    with pytest.raises(ValueError, match="t5_quant"):
        _load(_tiny_cfg(tmp_path, t5_quant="nf4"))
    with pytest.raises(ValueError, match="dit_quant"):
        _load(_tiny_cfg(tmp_path, dit_quant="int4"))
    with pytest.raises(ValueError, match="co-reside"):
        _load(_tiny_cfg(tmp_path, t5_quant="int8", dit_quant="int8_int4mlp"))
    asked = {"jax": [], "port": []}
    port_quantize = FluxPipeline.quantize

    def port_recorded(self, **kw):
        asked["port"].append({k: kw.get(k) for k in ("int4", "weight_only", "dit_int4_mlp")})
        return port_quantize(self, **kw)

    def jax_recorded(self, **kw):
        asked["jax"].append({k: kw.get(k) for k in ("int4", "weight_only", "dit_int4_mlp")})
        return self

    stub = lambda *a, **k: JaxFluxPipeline(dit_cfg=None, vae_cfg=None, t5_cfg=None, clip_cfg=None,  # noqa: E731
                                           params={"dit": {}, "t5": {}}, t5_tokenizer=None, clip_tokenizer=None)
    monkeypatch.setattr(FluxPipeline, "quantize", port_recorded)
    monkeypatch.setattr(JaxFluxPipeline, "quantize", jax_recorded)
    monkeypatch.setattr(JaxFluxPipeline, "random_init", stub)
    for kw in ({"dit_quant": "int8_int4mlp"}, {"t5_quant": "int4"}, {"dit_quant": "int8_int4mlp", "t5_quant": "int4"},
               {}, {"t5_quant": "int8"}):
        path = _tiny_cfg(tmp_path, **kw)
        pipe = _load(path)
        jcommon.load_pipeline(load_config(_args(path)), _args(path))
        assert pipe.rope_layout == "split" and asked["port"][-1] == asked["jax"][-1], (kw, asked)
    assert [a["dit_int4_mlp"] for a in asked["port"]] == [True, False, True, False, False]
    assert [a["int4"] for a in asked["port"]] == [("t5",)] * 3 + [()] * 2
    bad = _tiny_cfg(tmp_path, t5_quant="int8")
    with pytest.raises(ValueError, match="quantization\\s+is disabled"):
        _load(bad, quantize=None)
    assert _load(bad, quantize="none").rope_layout == "pair"  # an explicit override is allowed
    pipe = _load(_tiny_cfg(tmp_path, quantize="int8"), quantize=None)
    assert pipe.rope_layout == "split" and pipe.dit.rope_layout == "split"
    assert hasattr(pipe.dit.single_transformer_blocks[0], "in_proj")
    assert hasattr(pipe.dit.transformer_blocks[0].attn, "txt_qkv")


def test_noise_scaling_cli_int8_smoke(tmp_path):
    """`--quantize int8 --attn_impl pallas --synthetic_weights` end to end on the
    CPU. At tiny widths min_size leaves every linear float (as in JAX), so this
    checks the plumbing: the split layout and K2's plain version serve the run."""
    from reflectionflow_tpu_torch.cli.tts_t2i_noise_scaling import main

    (tmp_path / "meta.jsonl").write_text(json.dumps({"prompt": "a red cube", "tag": "colors"}) + "\n")
    before = fq.norm_rope.launches
    main(["--pipeline_config_path", str(_tiny_cfg(tmp_path)), "--meta_path", str(tmp_path / "meta.jsonl"),
          "--synthetic_weights", "--quantize", "int8", "--attn_impl", "pallas",
          "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    pngs = sorted(p.name for p in (tmp_path / "out").rglob("*.png"))
    assert len(pngs) == 2
    rows = [json.loads(line) for line in (tmp_path / "out" / "00000" / "metadata.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["num_noises"] == 2
    assert fq.norm_rope.launches == before  # CPU tensors never count as launches
