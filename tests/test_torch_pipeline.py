"""The PyTorch port's sampling loop, pipeline and noise-scaling CLI against the
JAX package.

Both pipelines hold the same tiny fp32 weights (the JAX random init, carried
by `utils/jax_bridge.py`) and take the same injected latents: seeded noise
differs between `jax.random` and `torch.Generator` (ROADMAP item 24), so
images are compared through injected latents, and the CLI through its
filenames and metadata rows, which depend only on the seeds.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config
from reflectionflow_tpu.sampler.generate import denoise as jax_denoise
from reflectionflow_tpu.sampler.generate import make_schedule as jax_make_schedule
from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline
from reflectionflow_tpu_torch import config as tconfig
from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids
from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule
from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline
from reflectionflow_tpu_torch.search.seeds import candidate_seeds as t_candidate_seeds
from reflectionflow_tpu_torch.utils import jax_bridge

from test_torch_flux_dit import _models

torch.set_num_threads(1)
CFGS = (FluxDiTConfig.tiny(), FluxVAEConfig.tiny(), T5Config.tiny(), CLIPTextConfig.tiny())


def test_denoise_three_steps_matches_jax():
    jcfg, params, dit = _models()
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((2, 16, jcfg.in_channels), dtype=np.float32)
    txt = rng.standard_normal((2, 6, jcfg.text_dim), dtype=np.float32)
    pooled = rng.standard_normal((2, jcfg.pooled_dim), dtype=np.float32)
    img_ids, txt_ids = make_image_ids(4, 4), make_text_ids(6)
    sigmas = make_schedule(3, 16)
    np.testing.assert_array_equal(sigmas.numpy(), np.asarray(jax_make_schedule(3, 16)))
    want = jax_denoise(jax.tree.map(jnp.asarray, params), jcfg, *map(jnp.asarray, (lat, txt, pooled, img_ids, txt_ids)),
                       jnp.asarray(sigmas.numpy()), jnp.asarray(3.5), 3)
    got = denoise(dit, *map(torch.from_numpy, (lat, txt, pooled, img_ids, txt_ids)), sigmas, 3.5, 3,
                  attn_impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _pipelines():
    jpipe = JaxFluxPipeline.random_init(jax.random.PRNGKey(0), *CFGS, dtype=jnp.float32)
    port_cfgs = [cls(**dataclasses.asdict(c)) for cls, c in zip(
        (tconfig.FluxDiTConfig, tconfig.FluxVAEConfig, tconfig.T5Config, tconfig.CLIPTextConfig), CFGS)]
    tpipe = FluxPipeline.random_init(torch.Generator().manual_seed(0), *port_cfgs, dtype=torch.float32)
    p = jax.tree.map(np.asarray, jpipe.params)
    tpipe.dit.load_state_dict(jax_bridge.dit_state_dict(p["dit"], CFGS[0]))
    tpipe.vae.load_state_dict(jax_bridge.vae_state_dict(p["vae"]))
    tpipe.t5.load_state_dict(jax_bridge.t5_state_dict(p["t5"], CFGS[2]))
    tpipe.clip.load_state_dict(jax_bridge.clip_state_dict(p["clip"], CFGS[3]))
    return jpipe, tpipe


def test_generate_with_injected_latents_matches_jax():
    jpipe, tpipe = _pipelines()
    tpipe.attn_impl = "pallas"
    prompts = ["a photo of a red cube", "two dogs on a bench"]
    lat = np.random.default_rng(9).standard_normal((2, 64, 16), dtype=np.float32)
    kw = dict(height=32, width=32, num_inference_steps=3, max_sequence_length=16)
    want = jpipe.generate(prompts, latents=jnp.asarray(lat), **kw)
    got = tpipe.generate(prompts, latents=lat, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 32, 32, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    # the same latents give the same images (the injection contract)
    np.testing.assert_array_equal(tpipe.generate(prompts, latents=lat, **kw), got)
    final = tpipe.generate(prompts, latents=lat, output_type="latent", **kw)
    np.testing.assert_array_equal(tpipe.decode_latents(final, 32, 32), got)


def test_seeded_generate_is_reproducible():
    tpipe = FluxPipeline.random_init(torch.Generator().manual_seed(0), *(
        cls.tiny() for cls in (tconfig.FluxDiTConfig, tconfig.FluxVAEConfig, tconfig.T5Config,
                               tconfig.CLIPTextConfig)), dtype=torch.float32)
    kw = dict(height=32, width=32, num_inference_steps=2, max_sequence_length=16)
    a = tpipe.generate(["x"], seed=7, output_type="latent", **kw)
    b = tpipe.generate(["x"], seed=7, output_type="latent", **kw)
    c = tpipe.generate(["x"], seed=8, output_type="latent", **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def _cli_tree(root):
    files = sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)
    meta = {}
    for f in files:
        if f.endswith("metadata.jsonl"):
            with open(os.path.join(root, f)) as fh:
                meta[f] = [json.loads(line) for line in fh]
    return files, meta


def test_noise_scaling_cli_artifacts_match_jax(tmp_path):
    from reflectionflow_tpu.cli.tts_t2i_noise_scaling import main as jax_main
    from reflectionflow_tpu_torch.cli.tts_t2i_noise_scaling import main as torch_main

    cfg = {"pipeline_args": {"torch_dtype": "fp32", "height": 16, "width": 16,
                             "max_sequence_length": 8, "num_inference_steps": 2},
           "search_args": {"search_branch": 2, "search_rounds": 2},
           "batch_size_for_img_gen": 4}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    rows = [{"prompt": "a red cube", "tag": "colors"}, {"prompt": "a dog", "tag": "single_object"},
            {"prompt": "a cat", "tag": "single_object"}]
    (tmp_path / "meta.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--pipeline_config_path", str(tmp_path / "cfg.json"), "--meta_path",
              str(tmp_path / "meta.jsonl"), "--synthetic_weights", "--seed", "3", "--start_index", "1"]
    jax_main(common + ["--output_dir", str(tmp_path / "jax"), "--attn_impl", "pallas_interpret"])
    torch_main(common + ["--output_dir", str(tmp_path / "torch"), "--attn_impl", "pallas",
                         "--device", "cpu"])
    jfiles, jmeta = _cli_tree(tmp_path / "jax")
    tfiles, tmeta = _cli_tree(tmp_path / "torch")
    assert tfiles == jfiles and tmeta == jmeta
    assert sum(f.endswith(".png") for f in tfiles) == 2 * 2 * 2  # prompts 1..2 x rounds x branch
    assert tmeta["00001/metadata.jsonl"][0]["seeds"] == t_candidate_seeds(3, 1, 1, 2)


def test_cli_device_defaults_to_cuda_without_fallback():
    """Both CLIs build on cuda unless told otherwise; without CUDA that raises
    and never silently takes the CPU."""
    from reflectionflow_tpu_torch.cli.common import build_parser, resolve_device
    from reflectionflow_tpu_torch.cli.train import build_parser as train_parser

    assert build_parser("x").parse_args(["--pipeline_config_path", "c"]).device == "cuda"
    assert train_parser().parse_args([]).device == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")
    with pytest.raises(ValueError, match="cuda"):
        resolve_device("meta")
