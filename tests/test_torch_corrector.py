"""The FLUX-Corrector's conditioned generate in the PyTorch port against the JAX
package: the serving DiT under the K9 and K8 impls, the conditioned `denoise`
with image CFG, `FluxPipeline.generate(conditions=...)`, the `lora_path`
loader, the corrector sampler CLI and the training validation hook.

Both packages hold the same weights (seeded numpy, or the JAX init carried by
`utils/jax_bridge.py`) and take the same numpy inputs. The port's pallas
impls run their kernels' plain versions on the CPU; the JAX package runs its
Pallas kernels in interpret mode. Bounds: the float serving DiT within 1e-4
of max |out| under "pallas_nr" and 1e-3 under "pallas_int8" (int8 logits),
the W8A8 one at cosine >= 0.9999 (int8 activation codes can flip); denoise
and generate (fp32) within 1e-4; folded LoRA weights within 1e-6; the CLI's
crops and resizes bit for bit (the port's copy of PIL's bicubic).
"""

import json
import os
import random
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from reflectionflow_tpu.cli import sample as jsample
from reflectionflow_tpu.lora import lora as jlora
from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.models.flux.dit import flux_dit_apply
from reflectionflow_tpu.ops.attention import _cond_bias_template
from reflectionflow_tpu.sampler.condition import Condition as JCondition
from reflectionflow_tpu.sampler.generate import denoise as jax_denoise
from reflectionflow_tpu.train.train_loop import export_diffusers_lora as jax_export_lora
from reflectionflow_tpu_torch.cli import sample as tsample
from reflectionflow_tpu_torch.cli.common import apply_lora_path
from reflectionflow_tpu_torch.config import TrainConfig, TTSConfig
from reflectionflow_tpu_torch.lora import lora as tlora
from reflectionflow_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
from reflectionflow_tpu_torch.ops.flash_attention_nr import flash_attention_nr
from reflectionflow_tpu_torch.sampler.condition import Condition, cot_position_delta
from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule
from reflectionflow_tpu_torch.search.artifacts import save_image
from reflectionflow_tpu_torch.train.data import decode_png
from reflectionflow_tpu_torch.train.train_loop import make_validation_hook
from reflectionflow_tpu_torch.utils import threefry
from reflectionflow_tpu_torch.utils.jax_bridge import dit_state_dict, lora_from_jax, serving_dit_from_jax

from test_torch_cond_dit import cond_inputs, jax_lora
from test_torch_flux_dit import _models, _t
from test_torch_pipeline import _pipelines
from test_torch_quant import _assert_same_as_tree, _jax_serving, numpy_models

torch.set_num_threads(1)
B, TY, TX, LT = 2, 4, 4, 8
MIN_SIZE = 4096  # quantizes every block linear of the test config

VARIANTS = {"no_cond": {}, "c_factor": {"c_factor": 2.0}, "no_union": {"union_cond_attn": False}}


@pytest.fixture(autouse=True)
def _fresh_cond_bias_cache():
    """The JAX reference `lru_cache`s its cond bias template; a template built
    while a jitted `denoise` traces holds a tracer, which an eager call at the
    same length in a later test of this worker would raise on. Clear it around
    every test."""
    _cond_bias_template.cache_clear()
    yield
    _cond_bias_template.cache_clear()


def _serving_inputs(cfg, with_cond, seed=0):
    rng = np.random.default_rng(seed)
    x = dict(img=rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32),
             txt=rng.standard_normal((B, LT, cfg.text_dim), dtype=np.float32),
             pooled=rng.standard_normal((B, cfg.pooled_dim), dtype=np.float32),
             timestep=np.asarray([0.7, 0.3], np.float32), img_ids=jrope.make_image_ids(TY, TX),
             txt_ids=jrope.make_text_ids(LT), guidance=np.asarray([3.5, 3.5], np.float32))
    if with_cond:
        x["cond"] = rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32)
        x["cond_ids"] = jrope.make_image_ids(TY, TX, position_delta=(0, -TX))
    return x


# (layout, cond variant): the float serving layout (fused panels, split RoPE, no
# int8 linears) in every cond variant, and the W8A8 layout with the cond stream
SERVING_CASES = [("float", v) for v in VARIANTS] + [("w8a8", "c_factor")]


@pytest.mark.parametrize("layout,variant", SERVING_CASES)
@pytest.mark.parametrize("impl", ["pallas_nr", "pallas_int8"])
def test_serving_dit_matches_jax(impl, layout, variant):
    """The split-layout DiT under K9 (or K2 + K8), plain versions, against the
    JAX serving forward with its interpret-mode kernels, without and with the
    cond stream; the impl's attention kernel is called once per block. In the
    float layout within 1e-4 (K9) / 1e-3 (K8) of max |out|. The W8A8 layout
    adds K3–K5, whose per-token int8 codes flip by one level where the two
    frameworks' fp32 sums differ in the last bit (the same inputs under plain
    "pallas" differ by up to 8e-3 of max |out| for some seeds), so it is held
    at the other serving tests' cosine >= 0.9999."""
    jcfg, params, dit = numpy_models(seed=5)
    tree = _jax_serving(params, jcfg, MIN_SIZE if layout == "w8a8" else 1 << 40, ())
    model = serving_dit_from_jax(jax.tree.map(np.asarray, tree), dit.cfg)
    kw = dict(VARIANTS[variant])
    x = _serving_inputs(jcfg, variant != "no_cond", seed=len(variant))
    want = np.asarray(flux_dit_apply(tree, jcfg, **{k: jnp.asarray(v) for k, v in x.items()},
                                     attn_impl=impl + "_interpret", rope_layout="split", **kw))
    kernel = flash_attention_nr if impl == "pallas_nr" else flash_attention_int8
    module = "models.flux.dit" if impl == "pallas_nr" else "ops.attention"
    calls = []
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(f"reflectionflow_tpu_torch.{module}.{kernel.__name__}",
                   lambda *a, **k: calls.append(1) or kernel(*a, **k))
        got = model(**{k: _t(v) for k, v in x.items()}, attn_impl=impl, rope_layout="split",
                    **kw).numpy()
    assert len(calls) == jcfg.num_double_blocks + jcfg.num_single_blocks
    if layout == "w8a8":
        a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999
    else:
        err = np.abs(got - want).max()
        assert err <= (1e-4 if impl == "pallas_nr" else 1e-3) * np.abs(want).max(), err


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_conditioned_denoise_with_image_cfg_matches_jax(impl):
    """Three Euler steps with the cond stream read through a LoRA view and
    image CFG (one doubled-batch forward per step): c_factor on "xla", the
    union mask off on "pallas". (The JAX `denoise` cannot trace a pallas impl
    with c_factor: `flux_dit_apply` takes float(jnp.log(c)) inside the jit.)"""
    jcfg, params, dit = _models()
    jl = jax_lora(params)
    jparams = jax.tree.map(jnp.asarray, params)
    x = cond_inputs(jcfg, seed=31)
    rng = np.random.default_rng(32)
    lat = rng.standard_normal(x["img"].shape, dtype=np.float32)
    empty = rng.standard_normal(x["cond"].shape, dtype=np.float32)
    sigmas = make_schedule(3, TY * TX)
    common = ("txt", "pooled", "img_ids", "txt_ids")
    kw = dict(image_guidance_scale=1.5,
              **({"union_cond_attn": False} if impl == "pallas" else {"c_factor": 2.0}))
    want = jax_denoise(jparams, jcfg, jnp.asarray(lat), *(jnp.asarray(x[k]) for k in common),
                       jnp.asarray(sigmas.numpy()), jnp.asarray(3.5), 3, cond=jnp.asarray(x["cond"]),
                       cond_ids=jnp.asarray(x["cond_ids"]), cond_empty=jnp.asarray(empty),
                       cond_dit_params=jlora.attach_lora(jparams, jax.tree.map(jnp.asarray, jl)),
                       attn_impl="pallas_interpret" if impl == "pallas" else "xla", **kw)
    got = denoise(dit, _t(lat), *(_t(x[k]) for k in common), sigmas, 3.5, 3, cond=_t(x["cond"]),
                  cond_ids=_t(x["cond_ids"]), cond_empty=_t(empty),
                  cond_dit_params=tlora.attach_lora(dit, lora_from_jax(jl, dit)), attn_impl=impl,
                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_conditioned_generate_matches_jax():
    """`generate(conditions=..., image_guidance_scale=1.5, condition_scale=2.0,
    prompts_2=...)` with injected latents, the cond stream reading the DiT
    folded with the same adapters on both sides. The port runs "pallas" (the
    structural log(c) bias), the JAX package "xla" (the dense one), since its
    jitted denoise cannot trace a pallas impl with c_factor."""
    jpipe, tpipe = _pipelines()
    jl = jax_lora(jax.tree.map(np.asarray, jpipe.params["dit"]), seed=12)
    _, jpipe.cond_dit_params = jlora.make_dit_param_views(jpipe.params["dit"], jax.tree.map(jnp.asarray, jl))
    _, tpipe.cond_dit_params = tlora.make_dit_param_views(tpipe.dit, lora_from_jax(jl, tpipe.dit))
    tpipe.attn_impl = "pallas"
    jpipe.attn_impl = "xla"
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    lat = rng.standard_normal((2, 64, 16), dtype=np.float32)
    kw = dict(height=32, width=32, num_inference_steps=3, max_sequence_length=16,
              image_guidance_scale=1.5, condition_scale=2.0, output_type="latent",
              prompts_2=["a red cube [Reflexion] make it blue", "a dog [Reflexion] add a hat"])
    prompts = ["a red cube", "a dog"]
    delta = cot_position_delta(16)
    want = jpipe.generate(prompts, latents=jnp.asarray(lat),
                          conditions=[JCondition("cot", im, position_delta=delta) for im in images], **kw)
    got = tpipe.generate(prompts, latents=lat,
                         conditions=[Condition("cot", im, position_delta=delta) for im in images], **kw)
    assert got.shape == (2, 64, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the cond stream acts: without conditions the result differs
    plain = tpipe.generate(prompts, latents=lat, **{**kw, "image_guidance_scale": 1.0})
    assert not torch.allclose(plain, got)


def test_quantize_transforms_the_cond_model():
    """`quantize` gives the folded cond model the DiT's serving layout and
    W8A8 linears, node for node as the JAX pipeline's `quantize`."""
    jpipe, tpipe = _pipelines()
    jl = jax_lora(jax.tree.map(np.asarray, jpipe.params["dit"]), seed=14)
    _, jpipe.cond_dit_params = jlora.make_dit_param_views(jpipe.params["dit"], jax.tree.map(jnp.asarray, jl))
    _, tpipe.cond_dit_params = tlora.make_dit_param_views(tpipe.dit, lora_from_jax(jl, tpipe.dit))
    kw = dict(min_size=MIN_SIZE, int4=(), weight_only=("t5",))
    jpipe.quantize(**kw)
    tpipe.quantize(**kw)
    assert tpipe.cond_dit_params.rope_layout == tpipe.dit.rope_layout == "split"
    modes = _assert_same_as_tree(tpipe.cond_dit_params, jpipe.cond_dit_params)
    assert modes == _assert_same_as_tree(tpipe.dit, jpipe.params["dit"])
    assert "double_blocks/attn/qkv" in modes["w8a8"]


def test_lora_path_folds_a_jax_written_file(tmp_path):
    """A diffusers-peft LoRA file written by the JAX package, loaded by the
    port's `lora_path` branch: the cond model holds the JAX fold of the same
    file, the main model the base weights; skipped under --synthetic_weights."""
    jcfg, params, dit = _models()
    jl = jax_lora(params, seed=4)
    path = str(tmp_path / "lora.safetensors")
    jax_export_lora(jl["adapters"], path, jl["_alpha"], jcfg.num_double_blocks, jcfg.num_single_blocks)
    from safetensors.numpy import load_file

    jread = jlora.convert_diffusers_lora(load_file(path), jcfg.num_double_blocks, jcfg.num_single_blocks)
    _, jcond = jlora.make_dit_param_views(jax.tree.map(jnp.asarray, params), jread)
    want = dit_state_dict(jax.tree.map(np.asarray, jcond), jcfg)

    cfg = TTSConfig()
    cfg.pipeline_args.lora_path = path
    pipe = Namespace(dit=dit, cond_dit_params=None)
    apply_lora_path(pipe, cfg, Namespace(synthetic_weights=True))
    assert pipe.cond_dit_params is None
    base = {k: v.clone() for k, v in dit.state_dict().items()}
    apply_lora_path(pipe, cfg, Namespace(synthetic_weights=False))
    assert pipe.dit is dit and all(torch.equal(v, dit.state_dict()[k]) for k, v in base.items())
    got = pipe.cond_dit_params.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, rtol=0, err_msg=k)
    assert not torch.equal(got["x_embedder.weight"], base["x_embedder.weight"])


def test_prep_pair_matches_the_pil_version():
    rng = np.random.default_rng(5)
    for bad_hw, good_hw in (((30, 40), (50, 37)), ((64, 48), None), ((24, 24), (24, 24))):
        bad = rng.integers(0, 256, (*bad_hw, 3), dtype=np.uint8)
        good = None if good_hw is None else rng.integers(0, 256, (*good_hw, 3), dtype=np.uint8)
        want = jsample._prep_pair(bad, good, 32, 16, random.Random(7))
        got = tsample._prep_pair(bad, good, 32, 16, random.Random(7))
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert g.shape == w.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


def test_items_and_reflections_as_jax(tmp_path):
    items = [{"prompt": "p", "reflection_prompt": "a", "instruction": "b"},
             {"prompt": "p", "instruction": "b", "reflection": "c"},
             {"prompt": "p", "reflection": "c"},
             {"prompt": "p", "edited_prompt_list": ["x", "y"]}]
    assert [tsample._reflection_of(i) for i in items] == [jsample._reflection_of(i) for i in items] \
        == ["a", "b", "c", "y"]
    with pytest.raises(ValueError, match="No reflection"):
        tsample._reflection_of({"prompt": "p"})
    (tmp_path / "list.json").write_text(json.dumps(items))
    (tmp_path / "one.json").write_text(json.dumps(items[0]))
    (tmp_path / "rows.jsonl").write_text("".join(json.dumps(i) + "\n\n" for i in items))
    for name in ("list.json", "one.json", "rows.jsonl"):
        path = str(tmp_path / name)
        assert tsample._load_items(path) == jsample._load_items(path)


def _sample_setup(tmp_path):
    cfg = {"pipeline_args": {"torch_dtype": "fp32", "height": 16, "width": 16, "condition_size": 8,
                             "max_sequence_length": 8, "num_inference_steps": 2}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(6)
    for name, hw in (("bad0.png", (20, 24)), ("good0.png", (18, 18)), ("bad1.png", (16, 16))):
        save_image(str(tmp_path / "img" / name), rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    items = [{"prompt": "a red cube", "bad_image": "bad0.png", "good_image": "good0.png",
              "reflection": "make it blue", "image_id": "cube"},
             {"prompt": "a dog", "bad_image": "bad1.png", "instruction": "add a hat"},
             {"prompt": "a cat", "bad_image": "bad1.png", "reflection": "smaller"}]
    (tmp_path / "meta.jsonl").write_text("".join(json.dumps(i) + "\n" for i in items))
    return ["--pipeline_config_path", str(tmp_path / "cfg.json"), "--meta_path",
            str(tmp_path / "meta.jsonl"), "--root_dir", str(tmp_path / "img"), "--synthetic_weights",
            "--start_index", "1", "--seed", "2", "--image_guidance_scale", "1.5"]


def test_sample_cli_writes_the_jax_sheets(tmp_path):
    """`--synthetic_weights --device cpu` end to end: the same file names and
    [condition | good | corrected] sheet shapes as the JAX CLI."""
    common = _sample_setup(tmp_path)
    jsample.main(common + ["--output_dir", str(tmp_path / "jax"), "--attn_impl", "pallas_interpret"])
    tsample.main(common + ["--output_dir", str(tmp_path / "torch"), "--attn_impl", "pallas",
                           "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["result_1.png", "result_2.png"]
    for name in names:
        got = decode_png((tmp_path / "torch" / name).read_bytes())
        want = np.asarray(Image.open(tmp_path / "jax" / name).convert("RGB"))
        assert got.shape == want.shape == (16, 32, 3)  # [condition | corrected]: no good image


def test_validation_hook_samples_and_restores(tmp_path):
    """Fires every `sample_interval` steps with the JAX file names, samples
    through a fold of the current adapters, and puts `cond_dit_params` back."""
    _, tpipe = _pipelines()
    tpipe.attn_impl = "pallas"
    cfg = TrainConfig()
    cfg.sample_interval = 2
    cfg.data.target_size, cfg.data.condition_size = 32, 16
    cfg.lora.r, cfg.lora.alpha = 4, 8.0
    lora = tlora.lora_init(threefry.prng_key(0), tpipe.dit, r=4, alpha=8.0)
    with torch.no_grad():
        for ab in lora["adapters"].values():
            ab["lora_B"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    val = [{"prompt": p, "condition": rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)}
           for p in ("a red cube", "a dog")]
    sentinel = object()
    tpipe.cond_dit_params = sentinel
    seen = []
    generate = tpipe.generate
    tpipe.generate = lambda *a, **k: seen.append(tpipe.cond_dit_params) or generate(*a, **k)
    hook = make_validation_hook(tpipe, cfg, val, str(tmp_path))
    hook(0, lora["adapters"], {})
    assert os.listdir(tmp_path) == [] and not seen
    hook(1, lora["adapters"], {})
    assert sorted(os.listdir(tmp_path)) == ["step2_00.png", "step2_01.png"]
    assert decode_png((tmp_path / "step2_00.png").read_bytes()).shape == (32, 32, 3)
    assert tpipe.cond_dit_params is sentinel
    # the fold of the current adapters served the cond stream
    folded = seen[0].state_dict()["x_embedder.weight"]
    want = tlora.fold_lora(tpipe.dit, lora).state_dict()["x_embedder.weight"]
    torch.testing.assert_close(folded, want, rtol=0, atol=0)
